"""Production meshes and the roofline's hardware constants, the port of
``repro/launch/mesh.py``.

A mesh is a ``torch.distributed`` ``DeviceMesh`` with named dims over
ranks ``0 .. prod(shape) - 1`` of the process group: :func:`make_mesh`
uses the group the process has, and where none exists it starts a
``fake`` one (rank 0 of :data:`FAKE_WORLD` ranks,
``torch.testing._internal.distributed.fake_pg``; the reference fakes 512
host devices), whose collectives move nothing: what the dry run
(``repro_torch.launch.dryrun``) needs to run a step as one device of a
(16, 16) or (2, 16, 16) mesh.  Functions, not module constants, so that importing this
module starts no process group.
"""
from __future__ import annotations

import math

import torch.distributed as dist

# NVIDIA H100 SXM5 (NVIDIA's H100 data sheet: dense rates, no sparsity),
# the card the port runs on: NVIDIA H100 80GB HBM3, power limit 700 W.
#: peak dense bf16 tensor-core FLOP/s of one card
PEAK_FLOPS_BF16 = 989e12
#: HBM3 bandwidth of one card, bytes/s
HBM_BW = 3.35e12
#: NVLink bandwidth of one card to the others of its host, bytes/s each
#: way (900 GB/s both ways)
NVLINK_BW = 450e9

#: ranks of the fake group :func:`make_mesh` starts (both production
#: meshes fit)
FAKE_WORLD = 512


def make_mesh(shape, axes, device_type: str | None = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over ranks ``0 ..
    prod(shape) - 1`` of the process group, started as a ``fake`` group
    of ``max(prod(shape), FAKE_WORLD)`` ranks when the process has none.
    ``device_type`` defaults to the card (``"cuda"``; raises without
    CUDA): ``"cpu"`` must be asked for, as the dry run (fake tensors) and
    the CPU tests do.  Raises if the process's group is smaller than the
    mesh."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch import _device
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    device_type = _device.resolve(device_type).type
    n = math.prod(shape)
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=max(n, FAKE_WORLD))
    elif dist.get_world_size() < n:
        raise RuntimeError(f"a {shape} mesh needs {n} ranks; the process "
                           f"group has {dist.get_world_size()}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model") with ``multi_pod``; ``device_type`` as :func:`make_mesh`."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_host_mesh(shape=None, axes=("data", "model"),
                   device_type: str | None = None):
    """A small mesh over the process group this process belongs to (its
    world size; one rank if it has no group: a ``fake`` one is started).
    ``shape`` defaults to ``(1, ..., world size)``; ``device_type`` to the
    card, as :func:`make_mesh` (the reference's host mesh covers
    ``jax.devices()``, the accelerator)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if shape is None:
        shape = (1,) * (len(axes) - 1) + (n,)
    return make_mesh(shape, axes, device_type)
