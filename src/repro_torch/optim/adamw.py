"""AdamW + cosine schedule + global-norm clipping, the port of
``repro/optim/adamw.py``.

Pure functions over named leaves: the gradients, moments and parameters
are ``{name: tensor}`` dicts keyed as ``ParamTree.named_parameters()``
names them, and :func:`adamw_update` returns new tensors (a new
``ParamTree`` of them) instead of updating in place, so a state a caller
keeps (a restart's initial state, a checkpoint's source) is never
changed under it.  Moments are stored in ``moment_dtype`` (bf16) and the
arithmetic is fp32, with an int32 step counter on the parameters'
device, as in the reference.  The reference computes this outside any
Pallas kernel, so the port computes it with plain tensor ops.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.telemetry import spans


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    moment_dtype: str = "bfloat16"


class OptState(NamedTuple):
    step: torch.Tensor       # () int32
    m: dict                  # {name: moment_dtype tensor}
    v: dict


def adamw_init(params, cfg: AdamWConfig) -> OptState:
    """Zero moments for every leaf of ``params`` (a ``ParamTree``) and a
    zero step, on the parameters' device."""
    dt = getattr(torch, cfg.moment_dtype)
    leaves = dict(params.named_parameters())
    dev = next(iter(leaves.values())).device
    zeros = lambda: {n: torch.zeros(p.shape, dtype=dt, device=dev)
                     for n, p in leaves.items()}
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=zeros(), v=zeros())


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr`` over ``warmup_steps``, then a cosine
    decay to 0 at ``total_steps``; fp32 of an int ``step`` tensor."""
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def global_norm(leaves) -> torch.Tensor:
    """The L2 norm of all leaves (an iterable or a dict's values), in
    fp32."""
    if isinstance(leaves, dict):
        leaves = leaves.values()
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))


def adamw_update(grads: dict, params, state: OptState, cfg: AdamWConfig):
    """One AdamW step: clip the gradients to ``clip_norm`` by their global
    norm, update the moments and the parameters in fp32, store them back
    in their dtypes.  -> ``(new params (a ParamTree), new OptState,
    {"lr", "grad_norm"})``, the metrics device tensors.  Records span
    ``train.adamw`` under ``torch.profiler``."""
    with spans.span("train.adamw"):
        return _update(grads, params, state, cfg)


def _update(grads: dict, params, state: OptState, cfg: AdamWConfig):
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                            1.0)
    stepf = step.float()
    bc1 = 1 - torch.pow(cfg.b1, stepf)
    bc2 = 1 - torch.pow(cfg.b2, stepf)
    new_p, new_m, new_v = {}, {}, {}
    with torch.no_grad():
        for name, p in params.named_parameters():
            m, v = state.m[name], state.v[name]
            g = grads[name].float() * scale
            m32 = m.float() * cfg.b1 + g * (1 - cfg.b1)
            v32 = v.float() * cfg.b2 + g * g * (1 - cfg.b2)
            mhat = m32 / bc1
            vhat = v32 / bc2
            pf = p.float()
            pnew = pf - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                              + cfg.weight_decay * pf)
            new_p[name] = pnew.to(p.dtype)
            new_m[name] = m32.to(m.dtype)
            new_v[name] = v32.to(v.dtype)
    return (params.replaced(new_p), OptState(step=step, m=new_m, v=new_v),
            {"lr": lr, "grad_norm": gnorm})
