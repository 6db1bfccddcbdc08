"""Input stand-ins and shardings for every dry-run cell, the port of
``repro/launch/specs.py``.

``cell_spec(arch, shape, mesh)`` returns the step's arguments as tensors
made with ``torch.empty`` (under a ``FakeTensorMode`` they are fake:
shapes and dtypes, nothing allocated) and, in a tree of the same
structure, their :class:`~repro_torch.sharding.NamedSharding`\\ s from the
divisibility-aware rule chooser; ``checkpoint.reshard_state(args,
shardings)`` makes them DTensors.  A ``ParamTree``'s shardings are
``{parameter name: sharding}``; cache states are annotated by (state
type, field) via ``_STATE_AXES``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs import SHAPES, get_arch
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import blocks as B
from repro_torch.models.layers import ParamTree
from repro_torch.models.model import VIS_FRAC, Batch, init_cache, param_defs
from repro_torch.optim.adamw import AdamWConfig, OptState
from repro_torch.sharding.rules import (DEFAULT_RULES, NamedSharding,
                                        ShardingRules, choose_spec)
from repro_torch.train.step import TrainState

# extend the default rules with the decode-cache sequence axis: for batch=1
# long-context cells the cache seq dim soaks up every idle mesh axis
CELL_RULES = ShardingRules(rules=DEFAULT_RULES.rules + (
    ("cache_seq", ("model", "data", "pod")),
))

# (state type, field) -> logical axes of the port's per-layer decode state
# (the reference keys them by (field, rank), with a leading group dim on
# its stacked states; here every layer has its own state)
_STATE_AXES = {
    (B.AttnState, "k"): ("batch", "cache_seq", "kv_heads", None),
    (B.AttnState, "v"): ("batch", "cache_seq", "kv_heads", None),
    (B.QuantAttnState, "k"): ("batch", "cache_seq", "kv_heads", None),
    (B.QuantAttnState, "v"): ("batch", "cache_seq", "kv_heads", None),
    (B.QuantAttnState, "k_scale"): ("batch", "cache_seq", "kv_heads"),
    (B.QuantAttnState, "v_scale"): ("batch", "cache_seq", "kv_heads"),
    (B.RGLRUState, "h"): ("batch", "embed_tp"),
    (B.RGLRUState, "conv"): ("batch", None, "embed_tp"),
    (B.MLSTMState, "C"): ("batch", "heads", None, None),
    (B.MLSTMState, "n"): ("batch", "heads", None),
    (B.MLSTMState, "m"): ("batch", "heads"),
    (B.SLSTMState, "c"): ("batch", "heads", None),
    (B.SLSTMState, "n"): ("batch", "heads", None),
    (B.SLSTMState, "h"): ("batch", "heads", None),
    (B.SLSTMState, "m"): ("batch", "heads", None),
}


def _ns(mesh, spec=()):
    return NamedSharding(mesh, tuple(spec))


def param_shardings(cfg: ModelConfig, mesh, rules=None) -> dict:
    """``{parameter name: NamedSharding}``, names as a ``ParamTree``'s
    ``named_parameters()`` gives them."""
    rules = rules or CELL_RULES
    out = {}

    def walk(defs, prefix):
        items = enumerate(defs) if isinstance(defs, list) else defs.items()
        for k, v in items:
            if isinstance(v, (dict, list)):
                walk(v, f"{prefix}{k}.")
            else:
                out[f"{prefix}{k}"] = _ns(mesh, choose_spec(
                    v.shape, v.logical_axes, mesh, rules))
    walk(param_defs(cfg), "")
    return out


def param_avals_and_shardings(cfg: ModelConfig, mesh, rules=None,
                              device="cpu"):
    """(a ``ParamTree`` of empty bf16 leaves, its shardings)."""
    return (ParamTree(param_defs(cfg), device=device),
            param_shardings(cfg, mesh, rules))


def opt_avals_and_shardings(cfg: ModelConfig, mesh, moment_dtype=None,
                            rules=None, device="cpu"):
    dt = moment_dtype or getattr(torch, AdamWConfig().moment_dtype)
    psh = param_shardings(cfg, mesh, rules)
    params = ParamTree(param_defs(cfg), device="meta")
    mom = lambda: {n: torch.empty(p.shape, dtype=dt, device=device)
                   for n, p in params.named_parameters()}
    return (OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                     m=mom(), v=mom()),
            OptState(step=_ns(mesh), m=psh, v=dict(psh)))


def batch_avals_and_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh,
                              *, with_labels: bool, decode: bool,
                              device="cpu"):
    Bg = shape.global_batch
    T = 1 if decode else shape.seq_len
    bax = choose_spec((Bg,), ("batch",), mesh, CELL_RULES)[0]
    bsh = lambda *extra: _ns(mesh, (bax,) + extra)
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)

    if cfg.frontend == "audio_stub":
        tokens, tsh = i32(Bg, T, cfg.n_codebooks), bsh(None, None)
    else:
        tokens, tsh = i32(Bg, T), bsh(None)
    if cfg.rope == "mrope":
        positions, psh = i32(Bg, T, 3), bsh(None, None)
    else:
        positions, psh = i32(Bg, T), bsh(None)
    labels = lsh = vis = vsh = None
    if with_labels:
        labels, lsh = i32(*tokens.shape), tsh
    if cfg.frontend == "vision_stub" and not decode:
        vis = torch.empty((Bg, T // VIS_FRAC, cfg.d_model),
                          dtype=torch.bfloat16, device=device)
        vsh = bsh(None, None)
    # decode writes the last slot of a full cache (ints, as the port's
    # Batch takes them)
    ci = shape.seq_len - 1 if decode else None
    cl = shape.seq_len if decode else None
    avals = Batch(tokens=tokens, positions=positions, labels=labels,
                  vis_embeds=vis, cache_index=ci, cache_len=cl)
    shs = Batch(tokens=tsh, positions=psh, labels=lsh, vis_embeds=vsh,
                cache_index=None, cache_len=None)
    return avals, shs


def state_axes(state) -> tuple:
    """Logical axes of every field of one layer's decode state."""
    return tuple(_STATE_AXES[(type(state), f)] for f in state._fields)


def cache_avals_and_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh,
                              device="cpu"):
    cache = init_cache(cfg, shape.global_batch, shape.seq_len,
                       device=device)
    shs = [type(st)(*(_ns(mesh, choose_spec(t.shape, axes, mesh,
                                             CELL_RULES))
                      for t, axes in zip(st, state_axes(st))))
           for st in cache]
    return cache, shs


class CellSpec(NamedTuple):
    """Everything needed to run one (arch x shape x mesh) cell."""
    kind: str
    args_avals: tuple
    args_shardings: tuple
    donate: tuple


def cell_spec(arch, shape_name: str, mesh, rules=None,
              device="cpu") -> CellSpec:
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape_name]
    pav, psh = param_avals_and_shardings(cfg, mesh, rules, device)
    if shape.kind == "train":
        oav, osh = opt_avals_and_shardings(cfg, mesh, rules=rules,
                                           device=device)
        bav, bsh = batch_avals_and_shardings(cfg, shape, mesh,
                                             with_labels=True, decode=False,
                                             device=device)
        pav.requires_grad_(True)
        return CellSpec("train", (TrainState(params=pav, opt=oav), bav),
                        (TrainState(params=psh, opt=osh), bsh), donate=(0,))
    if shape.kind == "prefill":
        bav, bsh = batch_avals_and_shardings(cfg, shape, mesh,
                                             with_labels=False, decode=False,
                                             device=device)
        return CellSpec("prefill", (pav, bav), (psh, bsh), donate=())
    if shape.kind == "decode":
        cav, csh = cache_avals_and_shardings(cfg, shape, mesh, device)
        bav, bsh = batch_avals_and_shardings(cfg, shape, mesh,
                                             with_labels=False, decode=True,
                                             device=device)
        return CellSpec("decode", (pav, cav, bav), (psh, csh, bsh),
                        donate=(1,))
    raise KeyError(shape.kind)


def step_fn_for(arch, shape_name: str, microbatch: int = 1):
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        from repro_torch.train.step import make_train_step
        return make_train_step(cfg, AdamWConfig(), microbatch=microbatch)
    if shape.kind == "prefill":
        from repro_torch.serve.step import make_prefill_step
        return make_prefill_step(cfg, cache_len=shape.seq_len)
    from repro_torch.serve.step import make_decode_step
    return make_decode_step(cfg)
