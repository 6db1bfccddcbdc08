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
dtype, and a DTensor leaf on its mesh with its placements (a checkpoint
holds each leaf whole: a DTensor is gathered first).
:func:`reshard_state` moves a state onto another device, or onto a mesh
with the sharding rules' placements (``repro_torch.sharding``).
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


def _full(t: torch.Tensor) -> torch.Tensor:
    """``t`` whole: a DTensor gathered (a collective on every rank of its
    mesh), a plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _encode(t: torch.Tensor):
    t = _full(t.detach()).cpu().contiguous()
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
    from torch.distributed.tensor import DTensor
    if isinstance(like, DTensor):
        return _place(t.to(like.dtype), like.device_mesh, like.placements)
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


def _place(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """``t`` as a DTensor on ``mesh`` with ``placements``: redistributed if
    it is one on that mesh already, else made whole and distributed (every
    rank must hold the same whole tensor, as ``distribute_tensor``
    asks).  A host tensor moves onto the mesh's device; a card's tensor
    onto a CPU mesh raises (the state would leave the card unasked)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    t = t.detach()
    if isinstance(t, DTensor) and t.device_mesh == mesh:
        return t.redistribute(mesh, placements)
    t = _full(t)
    if t.device.type != mesh.device_type:
        if t.device.type != "cpu":
            raise ValueError(f"reshard_state: a {t.device.type} tensor onto "
                             f"a {mesh.device_type} mesh (make the mesh on "
                             f"{t.device.type}: launch.mesh's default is "
                             "the card)")
        t = t.to(mesh.device_type)
    return distribute_tensor(t, mesh, placements)


def _map_shardings(tree, sh):
    """``tree``'s leaves placed by the same tree of ``NamedSharding``s
    (a ``ParamTree``'s as ``{name: sharding}``)."""
    if isinstance(tree, dict):
        return {k: _map_shardings(v, sh[k]) for k, v in tree.items()}
    if isinstance(tree, nn.Module):
        return tree.replaced({k: _map_shardings(v.detach(), sh[k])
                              for k, v in tree.named_parameters()})
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_shardings(v, s) for v, s in zip(tree, sh)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_shardings(v, s) for v, s in zip(tree, sh))
    if isinstance(tree, torch.Tensor):
        return _place(tree, sh.mesh, sh.placements)
    return tree


def reshard_state(state, target):
    """The same logical state on ``target`` (the reference's
    ``jax.device_put(state, shardings)``, the elastic-restore step): a
    device (every leaf whole on it), or a tree of the state's structure
    whose leaves are ``repro_torch.sharding.NamedSharding``s (a mesh and
    a spec; a ``ParamTree`` takes ``{parameter name: sharding}``), e.g.
    from ``repro_torch.launch.specs``."""
    if isinstance(target, (str, torch.device)):
        return _map_leaves(lambda t: _full(t).to(target), state)
    return _map_shardings(state, target)


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
