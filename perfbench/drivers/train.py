"""Training: the program's ``make_train_step`` with AdamW, steps back to
back on seeded zipf-bigram rows.

Set-up builds the weights from the seed, the program's train state and
step, and runs the traffic's ``setup_steps`` steps through the same call
and feed as the window (they warm up every shape the window uses).  From
them it keeps the program's readings: each checked step's loss, the
per-leaf norms of the first gradient as the optimizer got it (the first
moment after one step over ``1 - b1``), and the per-leaf norms of the
parameters' change after ``check_steps`` steps.  The window then runs
steps with no host read until ``--seconds`` have passed; the window ends
when the device has finished the last of them.  After it the program's
state is freed and the reference follows the checked steps from the same
weights and rows.
"""
from __future__ import annotations

from yardstick import compare, flops, tokens
from yardstick import model as wm
from yardstick import trace as tr


def batch(ctx, step: int, rows: int | None = None):
    """``(tokens, labels)`` of step ``step`` (from 1); the first ``rows``
    rows only when given."""
    t = ctx.cell.traffic
    toks, labels = tokens.train_rows(ctx.seed, step, t["batch"], t["seq"],
                                     ctx.model.vocab, t["zipf_a"], ctx.device)
    return (toks, labels) if rows is None else (toks[:rows], labels[:rows])


def program_batch(ctx, toks, labels):
    import torch
    from repro_torch.models.model import Batch
    B, T = toks.shape
    pos = torch.arange(T, dtype=torch.int32, device=ctx.device)[None]
    return Batch(tokens=toks, positions=pos.repeat(B, 1), labels=labels)


def change_norms(ctx, names: dict, params: dict):
    """Per-leaf norms of ``params - the seed's weights``, each kind made
    again from the seed one at a time."""
    import torch
    out, made = [], {}
    with torch.no_grad():
        for name, (kind, i) in names.items():
            if kind not in made:
                made = {kind: wm.make_weight(ctx.model, ctx.seed, kind,
                                             ctx.device)}
            old = made[kind] if i is None else made[kind][i]
            out.append((params[name].float() - old.float()).norm())
    return torch.stack(out)


def setup(ctx):
    """-> ``(state, step, readings)``: the program's train state after the
    set-up steps, its step, and the readings of the checked steps."""
    import torch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import make_train_step, train_init
    import program
    t, m = ctx.cell.traffic, ctx.model
    names = wm.leaf_names(m)
    cfg = program.config(m)
    oc = AdamWConfig(**t["adamw"])
    state = train_init(cfg, program.param_tree(m, wm.make_weights(
        m, ctx.seed, ctx.device)), oc)
    step = make_train_step(cfg, oc)
    ctx.mark("weights and AdamW state")
    losses, grad, delta = [], None, None
    for s in range(1, t["setup_steps"] + 1):
        state, met = step(state, program_batch(ctx, *batch(ctx, s)))
        losses.append(met["loss"])
        if s == 1:
            grad = torch.stack([state.opt.m[n].float().norm()
                                for n in names]) / (1 - t["adamw"]["b1"])
        if s == t["check_steps"]:
            delta = change_norms(ctx, names,
                                 dict(state.params.named_parameters()))
        ctx.mark(f"step {s}")
    readings = {"loss": [float(x) for x in losses[:t["check_steps"]]],
                "grad": grad.cpu(), "delta": delta.cpu()}
    return state, step, readings


def reference(ctx, precision: str = "fp32", rows: int | None = None):
    """The reference's readings of the checked steps (``rows``: only the
    first rows of each batch, a planted fault)."""
    ref = ctx.reference()
    t, m = ctx.cell.traffic, ctx.model
    make = lambda kind: wm.make_weight(m, ctx.seed, kind, ctx.device)
    return ref.train(m, make, list(wm.weight_kinds(m)),
                     [batch(ctx, s, rows)
                      for s in range(1, t["check_steps"] + 1)],
                     t["adamw"], wm.leaf_names(m), precision)


def run(ctx) -> dict:
    import torch
    t, m = ctx.cell.traffic, ctx.model
    state, step, prog = setup(ctx)
    n = 0
    with ctx.window() as win:
        while not win.over():
            s = t["setup_steps"] + n + 1
            with tr.span("batch"):
                b = program_batch(ctx, *batch(ctx, s))
            with tr.span("step"):
                state, _ = step(state, b)
            n += 1
    del state, step, b
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    B, T = t["batch"], t["seq"]
    return {
        "attempted": n, "failed": 0,
        "e2e": {"train_tok_s": n * B * T / ctx.window_s},
        "numbers": compare.train_numbers(prog, reference(ctx)),
        "info": {"kind": "train", "steps": n,
                 "model_flops": n * flops.train_step_flops(m, B, T),
                 "attn_fwd": flops.attn_fwd(B, T, m.n_heads, m.n_kv_heads,
                                            m.head_dim),
                 "attn_bwd": flops.attn_bwd(B, T, m.n_heads, m.n_kv_heads,
                                            m.head_dim),
                 "attn_bwd_calls": n * m.n_layers},
    }
