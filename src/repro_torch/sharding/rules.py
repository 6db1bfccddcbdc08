"""Logical-axis sharding rules with divisibility-aware fallback, the port
of ``repro/sharding/rules.py``.

Every parameter and input declares *logical* axis names; :func:`choose_spec`
maps them to mesh axes with the production rules below, skipping any
assignment whose dimension is not divisible by the mesh-axis size (e.g. 40
attention heads on a 16-way model axis) and falling back to the next
candidate dim.  A mesh axis is used at most once per spec.

Rules (single-pod (data, model) / multi-pod (pod, data, model)):
  batch      -> (pod, data)      data parallel across pods x pod-minors
  seq        -> data             sequence parallelism (long-context decode)
  vocab      -> model            embedding/logits TP
  ffn        -> model            MLP TP (megatron style)
  heads      -> model            attention-head TP when divisible
  qkv        -> model            flattened head*dim projection output
  embed_tp   -> model            fallback: shard d_model (FSDP-ish row TP)
  experts    -> model            expert parallelism (MoE)
  layers,embed,head_dim,window,... -> replicated

The record of a choice is a *spec*: a plain tuple with one entry per
tensor dim, ``None`` (replicated), one mesh-axis name, or a tuple of names
in the reference's order (``("model", "data")`` for an FSDP weight dim:
model-major).  It equals the reference's ``PartitionSpec`` entry by entry.

:func:`placements` turns a spec into DTensor placements over a
``DeviceMesh`` whose dim names are the mesh axes: mesh dim ``a`` gets
``Shard(i)`` if some tensor dim ``i`` names ``a``, else ``Replicate()``.
For a dim on two mesh axes DTensor orders the shards by mesh dim (the
earlier mesh dim is major), so ``("model", "data")`` on a ("data",
"model") mesh is laid out data-major: every device holds a block of the
same size as the reference's, but not the same block.  The per-dim axis
tuple stays the record; the layout is DTensor's.

The model runs on DTensors through a few helpers it calls, each the
identity on plain tensors: :func:`settle` (reduce a pending partial sum
now), :func:`shard_reshape` (a reshape that first gives up the shards it
cannot keep, and reshapes its gradient back the same way), :func:`fence`
(a gradient comes back with the forward's placements), and the
``local_map`` regions :func:`local_attention` and :func:`local_experts`
(each device on its own shards).  A step on DTensors runs under
``torch.distributed.tensor.experimental.implicit_replication()``: the
model's constants (RoPE's frequencies, masks) are plain tensors.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: tuple = (
        ("batch", ("pod", "data")),
        ("seq_shard", ("data",)),
        ("experts", ("model",)),     # EP first: experts own the model axis
        ("vocab", ("model",)),
        ("ffn", ("model",)),
        ("heads", ("model",)),
        ("qkv", ("model",)),
        ("embed_tp", ("model",)),
        ("kv_heads", ("model",)),
    )

    def candidates(self, logical: str) -> tuple:
        for name, axes in self.rules:
            if name == logical:
                return axes
        return ()


DEFAULT_RULES = ShardingRules()

# FSDP(+TP) rules: weight dims may additionally shard over the *data* axis
# (ZeRO-3 style fully-sharded weights + optimizer moments).  Activations
# keep batch on (pod, data); DTensor inserts the weight all-gathers and
# gradient reduce-scatters.  The memory lever for the 400B-scale cells.
FSDP_RULES = ShardingRules(rules=(
    ("batch", ("pod", "data")),
    ("seq_shard", ("data",)),
    ("experts", ("model",)),         # EP first: experts own the model axis
    ("vocab", ("model", "data")),
    ("ffn", ("model", "data")),
    ("heads", ("model",)),
    ("qkv", ("model", "data")),
    ("embed_tp", ("model", "data")),
    ("kv_heads", ("model",)),
))


def _mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` (or of any object with a
    ``shape`` dict, as the reference's tests fake a mesh)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return dict(mesh.shape)


def choose_spec(shape, logical_axes, mesh,
                rules: ShardingRules = DEFAULT_RULES) -> tuple:
    """Map per-dim logical names to a spec (one entry per dim).

    logical_axes: one logical name (or None) per dim.  Dims are assigned in
    rule-precedence order (so "ffn" wins the model axis over the
    "embed_tp" fallback dim); each mesh axis is assigned at most once;
    non-divisible assignments are skipped (the dim stays replicated or a
    later dim takes the mesh axis).
    """
    if len(shape) != len(logical_axes):
        raise ValueError(f"shape {tuple(shape)} has {len(shape)} dims, "
                         f"logical axes {logical_axes} {len(logical_axes)}")
    sizes = _mesh_shape(mesh)
    used: set = set()
    out: list = [None] * len(shape)
    prec = {name: i for i, (name, _) in enumerate(rules.rules)}
    order = sorted(range(len(shape)),
                   key=lambda i: prec.get(logical_axes[i], len(prec) + 1))
    for i in order:
        dim, logical = shape[i], logical_axes[i]
        if logical is None:
            continue
        # multi-axis assignment (e.g. batch over (pod, data)): every
        # available axis whose size keeps the product dividing the dim
        assign, prod = [], 1
        for ax in rules.candidates(logical):
            sz = sizes.get(ax, 0)
            if sz and ax not in used and dim % (prod * sz) == 0:
                assign.append(ax)
                prod *= sz
        if assign:
            used.update(assign)
            out[i] = tuple(assign) if len(assign) > 1 else assign[0]
    return tuple(out)


def spec_tree(defs, mesh, rules: ShardingRules = DEFAULT_RULES):
    """A ParamDef tree (dicts, lists) -> the same tree of specs."""
    if isinstance(defs, dict):
        return {k: spec_tree(v, mesh, rules) for k, v in defs.items()}
    if isinstance(defs, list):
        return [spec_tree(v, mesh, rules) for v in defs]
    return choose_spec(defs.shape, defs.logical_axes, mesh, rules)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` over ``mesh`` (a ``DeviceMesh`` with
    dim names): one per mesh dim, ``Shard(i)`` where tensor dim ``i``
    names that mesh axis, else ``Replicate()`` (module notes: a dim on
    several axes is laid out in mesh-dim order)."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for i, entry in enumerate(spec):
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None:
                where[ax] = i
    return tuple(Shard(where[ax]) if ax in where else Replicate()
                 for ax in mesh.mesh_dim_names)


class NamedSharding(NamedTuple):
    """A spec on a mesh: the counterpart of ``jax.sharding.NamedSharding``
    (what :func:`repro_torch.checkpoint.reshard_state` takes per leaf;
    :func:`placements` is the reference's ``named_sharding``)."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def settle(x):
    """``x`` with any pending partial sum reduced now, if it is a DTensor
    (a plain tensor is returned as it is).  DTensor's lookup in a
    vocab-sharded embedding leaves a masked partial sum whose mask only
    its first reader can apply; the embedding's output has several."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor) or not any(p.is_partial()
                                             for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


def shard_reshape(x, *shape):
    """``x.reshape(shape)``; a DTensor first gives up (replicates) every
    mesh dim whose shard the reshape cannot keep: a shard survives on the
    first dim that changes if that dim stays the leading part of its split
    or merge and its new size divides over the mesh dims that shard it
    (e.g. 40 heads of a 16-way sharded ``(B, T, 40 * 128)`` projection
    cannot split 16 ways).  Its gradient is reshaped back the same way."""
    if not is_dtensor(x):
        return x.reshape(shape)
    return _ShardReshape.apply(x, tuple(shape))


def _placed_reshape(x, shape):
    from torch.distributed.tensor import Replicate
    old = tuple(x.shape)
    new = _resolved(x, shape)
    first = next((i for i, (a, b) in enumerate(zip(old, new)) if a != b),
                 min(len(old), len(new)))
    mesh, pl = x.device_mesh, list(x.placements)
    ways: dict = {}
    for m, p in enumerate(pl):
        if p.is_shard():
            ways[p.dim] = ways.get(p.dim, 1) * mesh.size(m)
    keep = lambda d: d < first or (d == first and d < len(new)
                                    and new[d] % ways[d] == 0)
    new_pl = [Replicate() if p.is_shard() and not keep(p.dim) else p
              for p in pl]
    if new_pl != pl:
        x = x.redistribute(mesh, new_pl)
    return x.reshape(new)


class _ShardReshape(__import__("torch").autograd.Function):
    @staticmethod
    def forward(ctx, x, shape):
        ctx.in_shape = tuple(x.shape)
        return _placed_reshape(x, shape)

    @staticmethod
    def backward(ctx, grad):
        return _placed_reshape(grad, ctx.in_shape), None


def _resolved(x, shape) -> tuple:
    """``shape`` with a ``-1`` resolved against ``x.numel()``."""
    shape = tuple(int(s) for s in shape)
    if -1 in shape:
        rest = 1
        for s in shape:
            if s != -1:
                rest *= s
        shape = tuple(x.numel() // rest if s == -1 else s for s in shape)
    return shape


def _register_op_rules():
    """DTensor sharding rules for the ops the models use that some torch
    versions' DTensor has none for: ``F.logsigmoid``'s forward and
    backward (the xLSTM gates; any one dim sharded alike in and out, or
    all replicated; its CPU buffer has the input's shape, on CUDA it is
    empty: the rule is for the CPU dry run's fake tensors and 1-device
    meshes) and ``torch.roll`` (a local ring cache's prefill; any dim it
    does not roll sharded)."""
    import torch
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    aten = torch.ops.aten

    def each_dim(x, n_out: int, n_in: int, n_other: int = 0):
        rules = [([Replicate()] * n_out, [Replicate()] * n_in
                  + [None] * n_other)]
        for d in range(x.ndim):
            rules.append(([Shard(d)] * n_out, [Shard(d)] * n_in
                          + [None] * n_other))
        return rules

    @register_sharding(aten.log_sigmoid_forward.default)
    def _fwd(x):
        return each_dim(x, 2, 1)

    @register_sharding(aten.log_sigmoid_backward.default)
    def _bwd(grad, x, buffer):
        return each_dim(x, 1, 3)

    @register_sharding(aten.roll.default)
    def _roll(x, shifts, dims=()):
        rolled = {d % x.ndim for d in (dims or range(x.ndim))}
        return [r for r in each_dim(x, 1, 1, 2)
                if not (r[0][0].is_shard() and r[0][0].dim in rolled)]


if __import__("torch").distributed.is_available():
    _register_op_rules()


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local_attention(attend, q, k, v):
    """``attend(q, k, v)`` (the model's ``(B, T, H, D)`` layout, GQA) on
    DTensors, each device on its own shards (``local_map``): per mesh dim
    the batch stays sharded where q's is, the heads where q's are and the
    q head count splits, and anything else is replicated (a collective
    DTensor counts).  kv heads that cannot split alike over the mesh dims
    that shard q's heads are repeated to q's count first (each device
    then holds its q heads' kv heads; a local view, no collective), so a
    shard never splits a GQA group from its kv head."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    Hq, Hkv = q.shape[2], k.shape[2]
    heads = 1
    for m, p in enumerate(q.placements):
        if p == Shard(2):
            heads *= mesh.size(m)
    head_ok = Hq % heads == 0
    pl = tuple(p if p == Shard(0) or (p == Shard(2) and head_ok)
               else Replicate() for p in q.placements)
    if Shard(2) in pl and Hkv % heads:
        B, T, _, D = k.shape
        rep = Hq // Hkv
        k, v = (t.redistribute(mesh, tuple(
                    Replicate() if p == Shard(2) else p
                    for p in t.placements))
                [:, :, :, None].expand(B, T, Hkv, rep, D)
                .reshape(B, T, Hq, D) for t in (k, v))
    q, k, v = (t.redistribute(mesh, pl) for t in (q, k, v))
    return local_map(attend, out_placements=(pl,),
                     in_placements=(pl, pl, pl),
                     redistribute_inputs=False)(q, k, v)


def local_experts(experts, dispatch, combine, xg, w_gate, w_up, w_down):
    """``experts(dispatch (G, n, E, C), combine, xg (G, n, d), w_gate,
    w_up, w_down)`` (the grouped MoE's dispatch, expert MLPs and combine)
    on DTensors, each device on its own shards (``local_map``), per mesh
    dim: where the expert weights shard their experts, each device runs
    its experts on every token of its batch shard (the dispatch and
    combine masks cut alike) and the output is a partial sum over the
    dim (expert parallelism: the tokens are replicated there, so no
    all-to-all); where the tokens shard their groups, the groups stay
    sharded; anything else is replicated (a collective DTensor counts)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = xg.device_mesh
    masks, tokens, weights, out = [], [], [], []
    for m in range(mesh.ndim):
        if any(w.placements[m] == Shard(0) for w in (w_gate, w_up, w_down)):
            pl = (Shard(2), Replicate(), Shard(0), Partial())
        elif xg.placements[m] == Shard(0):
            pl = (Shard(0), Shard(0), Replicate(), Shard(0))
        else:
            pl = (Replicate(),) * 3 + (Replicate(),)
        for lst, p in zip((masks, tokens, weights, out), pl):
            lst.append(p)
    masks, tokens, weights, out = map(tuple, (masks, tokens, weights, out))
    args = [t.redistribute(mesh, pl) for t, pl in zip(
        (dispatch, combine, xg, w_gate, w_up, w_down),
        (masks, masks, tokens, weights, weights, weights))]
    return local_map(experts, out_placements=(out,),
                     in_placements=(masks, masks, tokens, weights, weights,
                                    weights),
                     redistribute_inputs=False)(*args)


def fence(x):
    """``x`` as it is; its gradient comes back with ``x``'s own placements
    (a DTensor's; a plain tensor passes untouched).  DTensor may hand a
    gradient back sharded on a dim that the forward kept whole (a partial
    sum reduce-scattered over the tokens), which later matrix products
    cannot take."""
    if not is_dtensor(x):
        return x
    return _Fence.apply(x)


class _Fence(__import__("torch").autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.spec = (x.device_mesh, tuple(x.placements))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        mesh, pl = ctx.spec
        return grad.redistribute(mesh, pl)
