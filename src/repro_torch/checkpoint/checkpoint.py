"""Checkpointing with atomic writes, the port of
``repro/checkpoint/checkpoint.py``.

A checkpoint is a directory holding ``arrays.npz`` (every leaf of the
state as a host array, bf16 as its ``uint16`` bits) and ``manifest.json``
(the step, the leaf keys and dtypes, and the caller's meta).  It is
written to a temporary directory beside its path and renamed into place,
so a reader never sees half of one.  The state is any nest of dicts,
NamedTuples, tuples, lists, ``ParamTree`` modules and tensors (a
``TrainState``); a leaf's key is its path joined with ``/``.

Restoring ``like`` a state puts every leaf on that state's device in its
dtype; :func:`reshard_state` moves a state to another device.  Sharding
over several cards is ROADMAP.md queue 1 item 12.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch
from torch import nn

_BITS = {torch.bfloat16: ("bfloat16", torch.int16, np.uint16)}


def _encode(t: torch.Tensor):
    t = t.detach().cpu().contiguous()
    if t.dtype in _BITS:
        name, as_int, view = _BITS[t.dtype]
        return t.view(as_int).numpy().view(view), name
    return t.numpy(), str(t.dtype).replace("torch.", "")


def _decode(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}/")
    elif isinstance(tree, nn.Module):
        for k, v in tree.named_parameters():
            yield f"{prefix}{k.replace('.', '/')}", v
    elif isinstance(tree, (tuple, list)):
        items = tree._asdict().items() if hasattr(tree, "_fields") else \
            enumerate(tree)
        for k, v in items:
            yield from _flatten(v, f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), tree


def tree_paths(tree) -> dict:
    """``{path: leaf}`` of a state."""
    return dict(_flatten(tree))


def save_checkpoint(path: str, step: int, state, meta: dict | None = None):
    """Atomic: write to a temporary directory, fsync, rename."""
    flat, dtypes = {}, {}
    for k, v in tree_paths(state).items():
        arr, dt = _encode(torch.as_tensor(v))
        flat[k] = arr
        dtypes[k] = dt
    tmp = tempfile.mkdtemp(dir=os.path.dirname(os.path.abspath(path)) or ".")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {"step": int(step), "keys": sorted(flat),
                    "dtypes": dtypes, "format": 1, **(meta or {})}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def load_checkpoint(path: str, like=None):
    """-> ``(state, manifest)``: ``{path: CPU tensor}`` without ``like``,
    else a state of ``like``'s structure with each leaf on its device in
    its dtype."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    arrays = np.load(os.path.join(path, "arrays.npz"))
    dtypes = manifest.get("dtypes", {})
    flat = {k: _decode(arrays[k], dtypes.get(k, str(arrays[k].dtype)))
            for k in manifest["keys"]}
    if like is None:
        return flat, manifest
    return _unflatten_like(like, flat), manifest


def _unflatten_like(like, flat, prefix=""):
    if isinstance(like, dict):
        return {k: _unflatten_like(v, flat, f"{prefix}{k}/")
                for k, v in like.items()}
    if isinstance(like, nn.Module):
        return like.replaced({
            k: _leaf_like(v, flat[f"{prefix}{k.replace('.', '/')}"])
            for k, v in like.named_parameters()})
    if hasattr(like, "_fields"):
        return type(like)(**{k: _unflatten_like(v, flat, f"{prefix}{k}/")
                             for k, v in like._asdict().items()})
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten_like(v, flat, f"{prefix}{i}/")
                          for i, v in enumerate(like))
    return _leaf_like(like, flat[prefix.rstrip("/")])


def _leaf_like(like, t: torch.Tensor) -> torch.Tensor:
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype).detach()
    return t


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, nn.Module):
        return tree.replaced({k: fn(v.detach())
                              for k, v in tree.named_parameters()})
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_leaves(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def reshard_state(state, device):
    """The same logical state with every leaf on ``device`` (the
    reference's ``device_put`` onto new shardings; one device here)."""
    return _map_leaves(lambda t: t.to(device), state)


class CheckpointManager:
    """Rolling checkpoints: save every `interval` steps, keep `keep`."""

    def __init__(self, directory: str, interval: int = 100, keep: int = 3):
        self.directory = directory
        self.interval = interval
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:010d}")

    def maybe_save(self, step: int, state, meta=None) -> str | None:
        if step % self.interval != 0:
            return None
        p = save_checkpoint(self._path(step), step, state, meta)
        self._gc()
        return p

    def _gc(self):
        ckpts = self.all_steps()
        for s in ckpts[:-self.keep]:
            shutil.rmtree(self._path(s), ignore_errors=True)

    def all_steps(self) -> list:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("ckpt_") and os.path.exists(
                    os.path.join(self.directory, name, "manifest.json")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def restore_latest(self, like=None):
        steps = self.all_steps()
        if not steps:
            return None, None
        return load_checkpoint(self._path(steps[-1]), like)
