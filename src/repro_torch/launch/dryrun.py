"""Dry run: one step of every (arch x shape x mesh) cell, run as one
device of the production mesh on fake tensors, and its per-device
memory, cost and collective statistics; the port of
``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
        --shape train_4k --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Results are cached as JSON under ``results/dryrun_torch/`` (one file per
cell).  Each carries ``"source": "repro_torch eager count"``: these are
the port's own numbers, counted op by op, not XLA's cost analysis.

How.  The process joins a ``fake`` process group of the mesh's size as
rank 0 (``launch.mesh``); the step's arguments are DTensors over fake
local tensors placed by the sharding rules (``launch.specs``), and the
port's own step (``make_train_step``, prefill, decode) runs eagerly on
them.  DTensor propagates each op's sharding, inserts the collectives a
placement change needs, and runs the op on this device's local shards.
A dispatch mode below DTensor (it hands every DTensor op on, and sees the
local ops DTensor then runs) counts, per device, the device's local work,
replicated work included:

* ``cost.flops``: each local op by ``torch.utils.flop_counter``'s
  formulas (``FlopCounterMode``'s registry; the attention operators
  register their own, the visible pairs the kernels visit).  A
  ``FlopCounterMode`` around a DTensor op would count the global op;
* ``cost.bytes_accessed``: every executed local op's input and output
  bytes (views excluded): an unfused upper bound, each op reading its
  inputs from and writing its outputs to memory;
* ``collectives``: the functional collectives DTensor issues, by the
  reference's five kinds, their bytes those of the tensor each produces
  (the reference counts an HLO collective's result type);
  ``CommDebugMode``'s own counts of the same step stand beside them
  (``comm_debug_counts``, uncounted by the xLSTM scaling below).  On this
  CPU mesh DTensor moves a shard from one tensor dim to another as
  all-gather + chunk (gloo has no all-to-all), so such moves count as
  all-gathers;
* ``memory.temp_bytes``: the peak of the live local bytes the step
  allocated (intermediates, collective buffers and its outputs), from
  the allocations the mode sees and their storages' release;
  ``argument_bytes`` / ``output_bytes`` the local bytes of the step's
  inputs and outputs, ``alias_bytes`` those of outputs that are inputs
  updated in place (the decode cache), ``code_bytes`` 0 (nothing is
  compiled).

The reference lowers two more probe models (``_probe_cost``) and sets
``models/flags.py``'s unroll flags because XLA's cost model counts a loop
body once; an eager count runs every iteration, so the port needs
neither.  The one loop it does not run whole is xLSTM's token recurrence
(mLSTM, sLSTM at ``T`` tokens: 32,768 sequential steps at
``prefill_32k``): the dry run runs one (layer, token) step, forward and
backward, and counts it ``T`` times (``"recurrence": "one step x T"`` in
the JSON), as the reference adds that part analytically.  Its
``temp_bytes`` then hold one step's states, not ``T``'s.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import SHAPES, get_arch, valid_cells
from repro_torch.launch.mesh import make_production_mesh

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
SOURCE = "repro_torch eager count"

#: functional collectives -> the reference's HLO kind names
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
_NOT_WORK = ("wait_tensor", "empty", "empty_strided", "empty_like",
             "new_empty", "new_empty_strided", "device")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


class LocalCounter(TorchDispatchMode):
    """Counts the local ops of one device (module notes).  Ops with a
    DTensor argument go on to DTensor (``NotImplemented``).  DTensor's own
    shape propagation runs each new op once at its global shapes on fake
    tensors; that is not this device's work: :func:`_propagation_paused`
    pauses the count around it, and ops on tensors of another fake mode
    are not counted either.  ``weight`` multiplies what is counted (the
    xLSTM recurrence's one step stands for ``T``)."""

    def __init__(self, fake_mode):
        super().__init__()
        self.fake_mode = fake_mode
        self.weight = 1
        self.paused = 0
        self.flops = 0
        #: FLOPs by op name (``aten.mm``, ``repro_torch.flash_fwd``, ...)
        self.by_op: dict = {}
        self.bytes = 0
        self.coll = {k: {"count": 0, "bytes": 0} for k in KINDS}
        self.live = 0
        self.peak = 0
        self._tracked: dict = {}

    def _mine(self, tensors) -> bool:
        return all(getattr(t, "fake_mode", None) is self.fake_mode
                   for t in tensors)

    def _track(self, t):
        st = t.untyped_storage()
        key = id(st)
        if key in self._tracked:
            return
        n = st.nbytes()
        self._tracked[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._release, key)

    def _release(self, key):
        self.live -= self._tracked.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        if any(isinstance(t, DTensor) for t in ins):
            return NotImplemented
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if self.paused or not self._mine(ins + outs):
            return out
        name = func._schema.name
        ns, _, short = name.partition("::")
        w = self.weight
        if ns == "_c10d_functional" or short in COLLECTIVE_KINDS:
            if short != "wait_tensor":
                kind = COLLECTIVE_KINDS.get(short, short)
                ent = self.coll.setdefault(kind, {"count": 0, "bytes": 0})
                ent["count"] += w
                ent["bytes"] += w * sum(_nbytes(t) for t in outs)
                for t in outs:
                    self._track(t)
            return out
        if short in _NOT_WORK:
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            f = w * int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += f
            key = str(packet)
            self.by_op[key] = self.by_op.get(key, 0) + f
        if not func.is_view:
            self.bytes += w * (sum(_nbytes(t) for t in ins)
                               + sum(_nbytes(t) for t in outs))
            for t in outs:
                self._track(t)
        return out

    def collectives(self) -> dict:
        return {"total_bytes": sum(e["bytes"] for e in self.coll.values()),
                "by_kind": self.coll}


@contextlib.contextmanager
def _propagation_paused(counter):
    """Pause ``counter`` while DTensor derives an op's global output
    shapes (``ShardingPropagator._propagate_tensor_meta_non_cached``, which
    runs the op on global-shape fake tensors)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    name = "_propagate_tensor_meta_non_cached"
    orig = getattr(ShardingPropagator, name, None)
    if orig is None:
        raise RuntimeError(f"this torch's DTensor has no ShardingPropagator."
                           f"{name}: the dry run cannot tell its shape "
                           "propagation from a device's work")

    def paused(self, *a, **kw):
        counter.paused += 1
        try:
            return orig(self, *a, **kw)
        finally:
            counter.paused -= 1

    setattr(ShardingPropagator, name, paused)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


@contextlib.contextmanager
def _one_token_step(counter, T: int):
    """xLSTM's token recurrence as one counted step standing for ``T``
    (module notes): the mLSTM/sLSTM scans run their cell on the first
    token only, under ``counter.weight = T``, forward and backward, and
    return that step's output for every position (a broadcast view)."""
    from repro_torch.models import blocks as B
    saved = B._mlstm_scan, B._slstm_scan

    def once(scan):
        def run(state, per_token, *consts):
            res = _OneStep.apply(counter, T, scan, state, len(per_token),
                                 *per_token, *consts)
            return type(state)(*res[1:]), res[0]
        return run

    B._mlstm_scan, B._slstm_scan = once(saved[0]), once(saved[1])
    try:
        yield
    finally:
        B._mlstm_scan, B._slstm_scan = saved


class _OneStep(torch.autograd.Function):
    """``scan(state, per_token, *consts)`` on the first token only, with
    ``counter.weight = T``; its backward runs that step's backward under
    the same weight (a gradient per token is the first token's,
    broadcast)."""

    @staticmethod
    def forward(ctx, counter, T, scan, state, n_tok, *xs):
        ctx.counter, ctx.T = counter, T
        ins = [(x[:, :1] if i < n_tok else x).detach()
               .requires_grad_(x.requires_grad) for i, x in enumerate(xs)]
        st = type(state)(*(s.detach() for s in state))
        prev, counter.weight = counter.weight, T
        try:
            # the step's own graph keeps its tensors: under a layer
            # group's checkpoint, unpacking them would recompute the whole
            # group (and count it T times)
            with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
                    lambda t: t, lambda t: t):
                new_state, hs = scan(st, tuple(ins[:n_tok]), *ins[n_tok:])
        finally:
            counter.weight = prev
        ctx.graph, ctx.n_tok = (ins, hs), n_tok
        ctx.shapes = [x.shape for x in xs]
        out = hs.detach().expand((hs.shape[0], T) + tuple(hs.shape[2:]))
        return (out, *(s.detach() for s in new_state))

    @staticmethod
    def backward(ctx, dout, *dstate):
        ins, hs = ctx.graph
        need = [x for x in ins if x.requires_grad]
        prev, ctx.counter.weight = ctx.counter.weight, ctx.T
        try:
            grads = iter(torch.autograd.grad(hs, need, dout[:, :1],
                                             allow_unused=True))
        finally:
            ctx.counter.weight = prev
        full = []
        for i, (x, shp) in enumerate(zip(ins, ctx.shapes)):
            g = next(grads) if x.requires_grad else None
            if g is not None and i < ctx.n_tok:
                g = g.expand(shp)
            full.append(g)
        return (None, None, None, None, None, *full)


def _args_bytes(tree) -> int:
    return sum(_nbytes(_local(t)) for t in tree_leaves(_as_leaves(tree)))


def _as_leaves(tree):
    """Tensors of a step's arguments or outputs (``ParamTree``s opened)."""
    from torch import nn
    if isinstance(tree, nn.Module):
        return [p for _, p in tree.named_parameters()]
    if isinstance(tree, dict):
        return [_as_leaves(v) for v in tree.values()]
    if isinstance(tree, (tuple, list)):
        return [_as_leaves(v) for v in tree]
    return tree if isinstance(tree, torch.Tensor) else []


@contextlib.contextmanager
def counting(fake_mode, T: int = 1):
    """Count what runs inside as one device's local work (module notes):
    yields the :class:`LocalCounter` (its ``comm`` attribute the
    ``CommDebugMode`` beside it).  DTensor ops mix with plain tensors as
    replicated ones (``implicit_replication``); ``T`` is the token count
    xLSTM's one counted recurrence step stands for."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication
    counter = LocalCounter(fake_mode)
    with implicit_replication(), _one_token_step(counter, T), \
            _propagation_paused(counter), CommDebugMode() as comm, counter:
        counter.comm = comm
        yield counter


def measure_cell(cfg, shape_name: str, mesh, rules=None,
                 microbatch: int = 1) -> dict:
    """Run one step of ``cfg`` at ``shape_name`` as device 0 of ``mesh``
    on fake tensors: ``{"kind", "memory", "cost", "collectives", ...}``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.checkpoint.checkpoint import reshard_state
    from repro_torch.launch.specs import cell_spec, step_fn_for

    shape = SHAPES[shape_name]
    t0 = time.time()
    with FakeTensorMode() as fm:
        cs = cell_spec(cfg, shape_name, mesh, rules=rules)
        args = reshard_state(cs.args_avals, cs.args_shardings)
        step = step_fn_for(cfg, shape_name, microbatch=microbatch)
        T = 1 if shape.kind == "decode" else shape.seq_len
        with counting(fm, T) as counter:
            out = step(*args)
        in_ids = {id(t) for t in tree_leaves(_as_leaves(args))}
        alias_bytes = sum(_nbytes(_local(t))
                          for t in tree_leaves(_as_leaves(out))
                          if id(t) in in_ids)
        return {
            "kind": cs.kind,
            "run_s": round(time.time() - t0, 2),
            "memory": {
                "argument_bytes": _args_bytes(args),
                "output_bytes": _args_bytes(out),
                "temp_bytes": counter.peak,
                "alias_bytes": alias_bytes,
                "code_bytes": 0,
            },
            "cost": {"flops": float(counter.flops),
                     "bytes_accessed": float(counter.bytes)},
            "flops_by_op": dict(sorted(counter.by_op.items())),
            "collectives": counter.collectives(),
            "comm_debug_counts": {str(k): int(v) for k, v in
                                  counter.comm.get_comm_counts().items()},
        }


def _opt_variant(cfg, shape_name: str):
    """Beyond-baseline configuration for --opt runs: FSDP(+TP) weight
    sharding for train/prefill cells, int8 KV cache for decode cells."""
    from repro_torch.launch.specs import CELL_RULES
    from repro_torch.sharding.rules import FSDP_RULES, ShardingRules
    kind = SHAPES[shape_name].kind
    rules = CELL_RULES
    if kind in ("train", "prefill"):
        rules = ShardingRules(rules=FSDP_RULES.rules + (
            ("cache_seq", ("model", "data", "pod")),))
    if kind == "decode":
        cfg = dataclasses.replace(cfg, kv_quant=True)
    return cfg, rules


def _baseline_variant(cfg, shape_name: str):
    """The paper-faithful baseline: flat global MoE dispatch, TP-only
    rules, bf16 KV cache."""
    if cfg.moe:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, grouped=False))
    return cfg, None


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str = RESULTS_DIR, force: bool = False,
             opt: bool = False, baseline_v2: bool = False,
             microbatch: int = 1) -> dict:
    mesh_name = "2x16x16" if multi_pod else "16x16"
    os.makedirs(out_dir, exist_ok=True)
    fname = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json")
    if os.path.exists(fname) and not force:
        with open(fname) as f:
            return json.load(f)
    cfg = get_arch(arch)
    rules = None
    if opt:
        cfg, rules = _opt_variant(cfg, shape_name)
    elif baseline_v2:
        cfg, rules = _baseline_variant(cfg, shape_name)
    # fake host tensors: the count needs no card
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    m = measure_cell(cfg, shape_name, mesh, rules=rules,
                     microbatch=microbatch)
    shape = SHAPES[shape_name]
    res = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "kind": m["kind"], "ok": True, "source": SOURCE,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "n_params": cfg.param_count(),
        "n_params_active": cfg.active_param_count(),
        "microbatch": microbatch, "run_s": m["run_s"],
        "memory": m["memory"], "cost": m["cost"],
        "collectives": m["collectives"],
        "flops_by_op": m["flops_by_op"],
        "comm_debug_counts": m["comm_debug_counts"],
        "notes": {
            "per_device": "one device's local work, replicated work "
                          "included",
            "bytes_accessed": "unfused upper bound: every executed op's "
                              "local input and output bytes",
            "code_bytes": "0: eager, nothing compiled",
        },
    }
    if any(k in ("mlstm", "slstm") for k in cfg.block_pattern) and \
            shape.kind != "decode":
        res["recurrence"] = "one step x T"
    with open(fname, "w") as f:
        json.dump(res, f, indent=1)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["16x16", "2x16x16", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--opt", action="store_true",
                    help="beyond-baseline variant (FSDP / int8 KV)")
    ap.add_argument("--baseline-v2", action="store_true",
                    help="baseline semantics (flat MoE, TP-only, bf16 KV)")
    ap.add_argument("--microbatch", type=int, default=1,
                    help="grad-accumulation microbatches (train cells)")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    if args.opt and args.out == RESULTS_DIR:
        args.out = RESULTS_DIR + "_opt"
    if args.baseline_v2 and args.out == RESULTS_DIR:
        args.out = RESULTS_DIR + "_base2"
    cells = valid_cells() if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.mesh == "both" else \
        [args.mesh == "2x16x16"]
    failures = []
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
            try:
                r = run_cell(arch, shape, mp, out_dir=args.out,
                             force=args.force, opt=args.opt,
                             baseline_v2=args.baseline_v2,
                             microbatch=args.microbatch)
                mem_gb = (r["memory"]["argument_bytes"]
                          + r["memory"]["temp_bytes"]) / 2**30
                print(f"OK   {tag:50s} run={r['run_s']:6.1f}s "
                      f"mem/dev={mem_gb:7.2f}GiB "
                      f"flops/dev={r['cost']['flops']:.3e} "
                      f"bytes/dev={r['cost']['bytes_accessed']:.3e} "
                      f"coll={r['collectives']['total_bytes']:.3e}B",
                      flush=True)
            except Exception as e:   # noqa: BLE001 — report every cell
                failures.append((tag, str(e)))
                print(f"FAIL {tag}: {e}", flush=True)
                traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: "
                         f"{[t for t, _ in failures]}")
    print("all cells passed")


if __name__ == "__main__":
    main()
