"""Training step: loss -> grad -> AdamW, with optional microbatching and a
gradient hook, the port of ``repro/train/step.py``.

``make_train_step`` returns ``step(state, batch) -> (state, metrics)``:
the state is not changed in place (the optimizer returns new tensors),
and the metrics (``loss``, ``aux_loss``, ``lr``, ``grad_norm``) stay
device tensors, so a step makes no host sync of its own.  On the card
every attention layer's forward runs the hand-written flash kernels
(twice per step: the layer groups are recomputed in the backward pass,
see ``models/model.py``) and its gradient the backward kernel
(``kernels/csrc/flash_attention_bwd.cu``).
"""
from __future__ import annotations

import itertools
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Batch, logits_and_loss
from repro_torch.optim.adamw import (AdamWConfig, OptState, adamw_init,
                                     adamw_update)
from repro_torch.telemetry import spans

AUX_WEIGHT = 0.01   # MoE load-balance loss weight


class TrainState(NamedTuple):
    params: object          # a ParamTree with trainable leaves
    opt: OptState


def train_init(cfg: ModelConfig, params, opt_cfg: AdamWConfig) -> TrainState:
    """Make ``params`` trainable (``requires_grad``) and zero the
    optimizer state."""
    params.requires_grad_(True)
    return TrainState(params=params, opt=adamw_init(params, opt_cfg))


def loss_fn(cfg: ModelConfig, params, batch: Batch):
    loss, aux = logits_and_loss(cfg, params, batch)
    return loss + AUX_WEIGHT * aux, (loss, aux)


def _split(batch: Batch, n: int, i: int) -> Batch:
    """Microbatch ``i`` of ``n``: rows ``[i B/n, (i + 1) B/n)`` of every
    tensor field."""
    return Batch(*(x.reshape((n, x.shape[0] // n) + x.shape[1:])[i]
                   if isinstance(x, torch.Tensor) else x for x in batch))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    microbatch: int = 1, grad_transform=None):
    """Build the train step.

    microbatch > 1: split the batch on dim 0 and accumulate fp32 grads
    over the microbatches in order, then divide by ``microbatch`` (the
    activation-memory knob; the reference's ``lax.scan``).
    grad_transform: optional ``grads -> grads`` hook on the ``{name:
    tensor}`` gradients before the optimizer (the reference's signature;
    ``runtime.compress.make_int8_compressor`` has its own ``(grads,
    residual)`` one and is not wired here, as in the reference).
    The step's spans (``repro_torch.telemetry.spans``) share the ids
    ``step`` (the step's number in this closure, from 0) and
    ``microbatch``.
    """
    steps = itertools.count()

    def single(params, batch):
        leaves = dict(params.named_parameters())
        tot, (loss, aux) = loss_fn(cfg, params, batch)
        grads = torch.autograd.grad(tot, list(leaves.values()),
                                    allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(leaves.items(), grads)}
        return grads, loss.detach(), aux.detach()

    def step(state: TrainState, batch: Batch):
        k = next(steps)
        if microbatch > 1:
            acc, losses, auxes = None, [], []
            for i in range(microbatch):
                spans.tag(step=k, microbatch=i)
                g, l, a = single(state.params, _split(batch, microbatch, i))
                acc = {n: x.float() for n, x in g.items()} if acc is None \
                    else {n: acc[n] + g[n] for n in acc}
                losses.append(l)
                auxes.append(a)
            grads = {n: x / microbatch for n, x in acc.items()}
            loss = torch.stack(losses).mean()
            aux = torch.stack(auxes).mean()
        else:
            spans.tag(step=k, microbatch=0)
            grads, loss, aux = single(state.params, batch)

        spans.tag(step=k)
        if grad_transform is not None:
            grads = grad_transform(grads)

        params, opt, om = adamw_update(grads, state.params, state.opt,
                                       opt_cfg)
        return TrainState(params=params, opt=opt), \
            {"loss": loss, "aux_loss": aux, **om}

    return step
